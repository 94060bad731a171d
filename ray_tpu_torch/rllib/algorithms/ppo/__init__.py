from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPO, PPOConfig, PPOLearner

__all__ = ["PPO", "PPOConfig", "PPOLearner"]
