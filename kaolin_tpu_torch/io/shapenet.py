"""ShapeNet dataset wrappers. Counterpart of ``kaolin_tpu/io/shapenet.py``.

Directory-scanning datasets over local ShapeNet V1/V2 trees; items are
imported lazily with :func:`kaolin_tpu_torch.io.obj.import_mesh`, on
``device`` (the CUDA device unless named).
"""

import os

__all__ = ["ShapeNetV1", "ShapeNetV2"]

# common synset name → id map (subset; users can pass raw synset ids too)
_SYNSETS = {
    "airplane": "02691156", "bench": "02828884", "cabinet": "02933112",
    "car": "02958343", "chair": "03001627", "display": "03211117",
    "lamp": "03636649", "loudspeaker": "03691459", "rifle": "04090263",
    "sofa": "04256520", "table": "04379243", "telephone": "04401088",
    "watercraft": "04530566",
}


class _ShapeNetBase:
    MODEL_REL_PATH = None

    def __init__(self, root, categories=None, train=True, split=0.7,
                 with_materials=False, device=None):
        self.root = root
        self.with_materials = with_materials
        self.device = device
        if categories is None:
            synsets = sorted(d for d in os.listdir(root)
                             if os.path.isdir(os.path.join(root, d)))
        else:
            synsets = [_SYNSETS.get(c, c) for c in categories]
        self.paths = []
        self.synset_idxs = []
        self.synsets = synsets
        for si, synset in enumerate(synsets):
            syn_dir = os.path.join(root, synset)
            if not os.path.isdir(syn_dir):
                raise ValueError(f"synset dir {syn_dir} not found")
            models = sorted(os.listdir(syn_dir))
            cutoff = int(len(models) * split)
            models = models[:cutoff] if train else models[cutoff:]
            for m in models:
                p = os.path.join(syn_dir, m, self.MODEL_REL_PATH)
                if os.path.exists(p):
                    self.paths.append(p)
                    self.synset_idxs.append(si)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index):
        from kaolin_tpu_torch.io import obj
        mesh = obj.import_mesh(self.paths[index],
                               with_materials=self.with_materials,
                               triangulate=True, device=self.device)
        return {"mesh": mesh, "synset": self.synsets[self.synset_idxs[index]],
                "path": self.paths[index]}


class ShapeNetV1(_ShapeNetBase):
    """ShapeNetCore V1 layout: <root>/<synset>/<model>/model.obj."""
    MODEL_REL_PATH = "model.obj"


class ShapeNetV2(_ShapeNetBase):
    """ShapeNetCore V2 layout:
    <root>/<synset>/<model>/models/model_normalized.obj."""
    MODEL_REL_PATH = os.path.join("models", "model_normalized.obj")
