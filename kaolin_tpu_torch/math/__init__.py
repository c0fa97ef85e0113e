from kaolin_tpu_torch.math import quat  # noqa: F401
