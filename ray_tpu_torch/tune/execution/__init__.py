"""Trial execution."""
from ray_tpu_torch.tune.execution.tune_controller import TuneController  # noqa
