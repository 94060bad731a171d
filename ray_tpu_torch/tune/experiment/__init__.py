"""Experiment metadata."""
from ray_tpu_torch.tune.experiment.trial import Trial  # noqa
