from kaolin_tpu_torch.rep.spc import Spc  # noqa: F401
