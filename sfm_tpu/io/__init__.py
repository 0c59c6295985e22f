from sfm_tpu.io.calib import Calibration, read_pars, write_pars  # noqa: F401
from sfm_tpu.io.images import load_images, read_pnm, to_gray, write_pnm  # noqa: F401
from sfm_tpu.io.ply import export_ply  # noqa: F401
