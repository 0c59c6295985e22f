from sfm_tpu.utils.platform import default_backend, resolve_ba_dtype  # noqa: F401
from sfm_tpu.utils.metrics import Metrics, StageTimer  # noqa: F401
