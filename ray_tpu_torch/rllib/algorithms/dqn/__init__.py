from ray_tpu_torch.rllib.algorithms.dqn.dqn import DQN, DQNConfig, DQNLearner, DQNModule

__all__ = ["DQN", "DQNConfig", "DQNLearner", "DQNModule"]
