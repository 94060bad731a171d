"""Search algorithms."""
from ray_tpu_torch.tune.search.sample import *  # noqa
from ray_tpu_torch.tune.search.searcher import BasicVariantGenerator, ConcurrencyLimiter, RandomSearch, Searcher  # noqa
from ray_tpu_torch.tune.search.tpe import TPESearch  # noqa
