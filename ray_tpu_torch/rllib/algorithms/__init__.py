from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig

__all__ = ["Algorithm", "AlgorithmConfig"]
