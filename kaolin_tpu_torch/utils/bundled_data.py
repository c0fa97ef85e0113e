"""Bundled and downloadable sample data.

Counterpart of ``kaolin_tpu/utils/bundled_data.py``: the paths of the
sample-data tree and two downloadable gaussian datasets, checked by their
MD5 sums. A download is fetched with ``urllib`` only when the files are
missing or differ; where the fetch fails (a machine without network), a
``RuntimeError`` says where to place the files.
"""

import hashlib
import os
import zipfile

from kaolin_tpu_torch.utils.env_vars import KaolinEnvVars

__all__ = [
    "BUNDLED_DATA_PATH", "SAMPLE_MESHES_PATH", "SCANNED_TOYS_PATH",
    "SCANNED_TOYS_NAMES", "TENSOR_IR_PATH", "TENSOR_IR_NAMES",
    "download_scanned_toys_dataset", "download_tensor_ir_dataset",
]

#: the sample_data tree beside the package root
BUNDLED_DATA_PATH = os.getenv(KaolinEnvVars.BUNDLED_DATA_DIR.value) \
    or os.path.realpath(os.path.join(
        os.path.abspath(os.path.dirname(__file__)), os.pardir, os.pardir,
        "sample_data"))
SAMPLE_MESHES_PATH = os.path.join(BUNDLED_DATA_PATH, "meshes")
SCANNED_TOYS_PATH = os.getenv(KaolinEnvVars.SCANNED_TOYS_PATH.value) \
    or os.path.join(BUNDLED_DATA_PATH, "scanned_toys")
TENSOR_IR_PATH = os.getenv("KAOLIN_TENSOR_IR_PATH") \
    or os.path.join(BUNDLED_DATA_PATH, "tensor_ir")

SCANNED_TOYS_NAMES = ["BluehairRagdoll", "bublik_octopus", "knit_meow",
                      "mer_elephant", "stink_raccoon", "sunflower_baby"]
TENSOR_IR_NAMES = ["tensorir_ficus", "tensorir_lego"]

_S3 = "https://nvidia-kaolin.s3.us-east-2.amazonaws.com/data"

_TOYS_PLY_CHECKSUMS = {
    "BluehairRagdoll.ply": "f3a6591e7dc497d2fdbd1bb654f01baf",
    "bublik_octopus.ply": "4bd216545854171ef69d5c62a0aea369",
    "knit_meow.ply": "f413b1f5c3cc7ccbc724643749f06d57",
    "mer_elephant.ply": "613f87a424c9eba9ecafd8b91150330c",
    "stink_raccoon.ply": "e78798c1d2b6b4262b6c05636022fa15",
    "sunflower_baby.ply": "5f464485ac524c09e3a9b8a9f7d2b7d5",
}
_TENSOR_IR_PLY_CHECKSUMS = {
    "tensorir_ficus.ply": "2c2c3bf45dd26038e84acca32cd95a74",
    "tensorir_lego.ply": "f382c20a563877b97a953537e90c8410",
}


def _have_expected_files(root, file_to_checksum):
    for name, md5 in file_to_checksum.items():
        path = os.path.join(root, name)
        if not os.path.exists(path):
            return False, f"missing {path}"
        with open(path, "rb") as f:
            if md5 != hashlib.md5(f.read()).hexdigest():
                return False, f"md5 mismatch for {path}"
    return True, ""


def _fetch(url, target):
    import urllib.request
    urllib.request.urlretrieve(url, target)


def _fetch_unzip(url, root):
    target = os.path.join(root, os.path.basename(url))
    try:
        _fetch(url, target)
    except Exception as e:  # a machine without network, among others
        raise RuntimeError(
            f"Could not download {url} ({e}); if this environment has no "
            f"network access, place the dataset files under {root} "
            f"manually.") from e
    with zipfile.ZipFile(target, "r") as zf:
        zf.extractall(root)
    os.remove(target)


def _download_if_needed(url, root, checksums):
    have, _ = _have_expected_files(root, checksums)
    if not have:
        _fetch_unzip(url, root)
        have, msg = _have_expected_files(root, checksums)
        if not have:
            raise RuntimeError(f"After download of {url}: {msg}")


def download_scanned_toys_dataset():
    """The Kaolin scanned-toys gaussian dataset (its PLY files) under
    ``SCANNED_TOYS_PATH``, fetched if missing → that path."""
    os.makedirs(SCANNED_TOYS_PATH, exist_ok=True)
    _download_if_needed(f"{_S3}/toys_gaussians.ply.zip", SCANNED_TOYS_PATH,
                        _TOYS_PLY_CHECKSUMS)
    return SCANNED_TOYS_PATH


def download_tensor_ir_dataset():
    """The Tensor-IR sample gaussians under ``TENSOR_IR_PATH``, fetched if
    missing → that path."""
    os.makedirs(TENSOR_IR_PATH, exist_ok=True)
    _download_if_needed(f"{_S3}/tensor_ir.ply.zip", TENSOR_IR_PATH,
                        _TENSOR_IR_PLY_CHECKSUMS)
    return TENSOR_IR_PATH
