from kaolin_tpu_torch.ops import spc  # noqa: F401
