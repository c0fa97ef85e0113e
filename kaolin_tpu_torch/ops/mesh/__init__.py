from kaolin_tpu_torch.ops.mesh.check_sign import check_sign  # noqa: F401
