"""SHREC16 dataset wrapper. Counterpart of ``kaolin_tpu/io/shrec.py``.
Layout: <root>/<category>/<train|test|val>/<name>.obj; items on ``device``
(the CUDA device unless named)."""

import os

__all__ = ["SHREC16"]


class SHREC16:
    def __init__(self, root, categories=None, split="train", device=None):
        if split not in ("train", "test", "val"):
            raise ValueError(f"split {split!r} is not train, test or val")
        self.root = root
        self.device = device
        if categories is None:
            categories = sorted(d for d in os.listdir(root)
                                if os.path.isdir(os.path.join(root, d)))
        self.categories = categories
        self.paths = []
        self.labels = []
        for ci, cat in enumerate(categories):
            d = os.path.join(root, cat, split)
            if not os.path.isdir(d):
                continue
            for fn in sorted(os.listdir(d)):
                if fn.endswith(".obj"):
                    self.paths.append(os.path.join(d, fn))
                    self.labels.append(ci)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index):
        from kaolin_tpu_torch.io import obj
        mesh = obj.import_mesh(self.paths[index], triangulate=True,
                               device=self.device)
        return {"mesh": mesh,
                "category": self.categories[self.labels[index]],
                "label": self.labels[index]}
