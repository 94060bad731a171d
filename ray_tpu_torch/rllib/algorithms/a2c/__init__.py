from ray_tpu_torch.rllib.algorithms.a2c.a2c import A2C, A2CConfig, A2CLearner

__all__ = ["A2C", "A2CConfig", "A2CLearner"]
