from ray_tpu_torch.rllib.algorithms.cql.cql import CQL, CQLConfig, CQLLearner

__all__ = ["CQL", "CQLConfig", "CQLLearner"]
