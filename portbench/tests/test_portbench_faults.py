"""A run with the timed path broken underneath (the look for a card
skipped, the rest of the run driven as the benchmark drives it) comes out
not correct, for each fault a one-card fit can have: a step that leaves
its state unchanged, half of the batch left out with the mean taken over
the rest, and an answer altered where it is produced. (The cells run on
one card: there is no exchange between cards to leave out.)"""

import pytest
import torch

from portbench import harness
from portbench.fits import dibr
from portbench.tests.conftest import CELLS, SEED, small


def _unchanged(monkeypatch):
    step = torch.optim.Adam.step

    def unchanged(self, *a, **k):
        params = [p for g in self.param_groups for p in g["params"]]
        before = [p.detach().clone() for p in params]
        step(self, *a, **k)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(b)

    monkeypatch.setattr(torch.optim.Adam, "step", unchanged)


def _half_batch(monkeypatch):
    whole = dibr.losses

    def half(scene, params, image, soft):
        keep = slice(0, image.shape[0] // 2)
        sub = {**scene, "target_image": scene["target_image"][keep],
               "target_mask": scene["target_mask"][keep]}
        return whole(sub, params, image[keep], soft[keep])

    monkeypatch.setattr(dibr, "losses", half)


def _altered(monkeypatch):
    sample = dibr.texture_mapping

    def altered(uv, texture, mode):
        out = sample(uv, texture, mode=mode).clone()
        out[0, out.shape[1] // 2, out.shape[2] // 2, 0] += 0.25
        return out

    monkeypatch.setattr(dibr, "texture_mapping", altered)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("plant", (_unchanged, _half_batch, _altered),
                         ids=("unchanged", "half_batch", "altered"))
def test_fault_is_not_correct(monkeypatch, workload, plant):
    plant(monkeypatch)
    out = harness.run_cell(workload, SEED, 0.2, False, "cpu",
                           cfg=small(workload))
    assert not out["correct"], out["checks"]
