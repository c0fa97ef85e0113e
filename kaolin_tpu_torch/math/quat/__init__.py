from kaolin_tpu_torch.math.quat.quaternion import *   # noqa: F401,F403
from kaolin_tpu_torch.math.quat.rotation33 import *   # noqa: F401,F403
from kaolin_tpu_torch.math.quat.matrix44 import *     # noqa: F401,F403
from kaolin_tpu_torch.math.quat.angle_axis import *   # noqa: F401,F403
from kaolin_tpu_torch.math.quat.euclidean import *    # noqa: F401,F403
from kaolin_tpu_torch.math.quat.transform import *    # noqa: F401,F403
from kaolin_tpu_torch.math.quat.util import *         # noqa: F401,F403
