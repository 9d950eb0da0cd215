"""Host-side utilities of the port: table-layout conversion, results.json,
run logging, seeding and tracing (``tracing.py``)."""

from deepfm_tpu_torch.utils.io import save_results
from deepfm_tpu_torch.utils.logging import get_logger
from deepfm_tpu_torch.utils.seeding import seed_everything

__all__ = ["get_logger", "save_results", "seed_everything"]
