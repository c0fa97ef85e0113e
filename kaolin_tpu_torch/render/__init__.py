from kaolin_tpu_torch.render import mesh  # noqa: F401
