"""ray_tpu_torch.tune — hyperparameter search (reference: python/ray/tune/).

Built purely on the public task/actor API, like the reference: the controller
is an event loop over trial actors (tune/execution/tune_controller.py:49).
"""

from ray_tpu_torch.tune.result_grid import ResultGrid
from ray_tpu_torch.tune.schedulers import (
    AsyncHyperBandScheduler,
    DistributeResources,
    FIFOScheduler,
    HyperBandForBOHB,
    HyperBandScheduler,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
    ResourceChangingScheduler,
    TrialScheduler,
)
from ray_tpu_torch.tune.search.sample import (
    choice,
    grid_search,
    loguniform,
    qrandn,
    quniform,
    randint,
    randn,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.search.searcher import (
    BasicVariantGenerator,
    ConcurrencyLimiter,
    RandomSearch,
    Searcher,
)
from ray_tpu_torch.tune.search.bohb import TuneBOHB
from ray_tpu_torch.tune.search.tpe import TPESearch
from ray_tpu_torch.tune.trainable import Trainable, with_parameters, wrap_function
from ray_tpu_torch.tune.tuner import TuneConfig, Tuner, run

# ASHAScheduler is the reference's public alias.
ASHAScheduler = AsyncHyperBandScheduler

__all__ = [
    "ASHAScheduler",
    "AsyncHyperBandScheduler",
    "DistributeResources",
    "HyperBandForBOHB",
    "HyperBandScheduler",
    "ResourceChangingScheduler",
    "TuneBOHB",
    "BasicVariantGenerator",
    "ConcurrencyLimiter",
    "FIFOScheduler",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "RandomSearch",
    "TPESearch",
    "PB2",
    "ResultGrid",
    "Searcher",
    "Trainable",
    "TrialScheduler",
    "TuneConfig",
    "Tuner",
    "choice",
    "grid_search",
    "loguniform",
    "qrandn",
    "quniform",
    "randint",
    "randn",
    "run",
    "sample_from",
    "uniform",
    "with_parameters",
    "wrap_function",
]
