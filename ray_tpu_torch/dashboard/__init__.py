from ray_tpu_torch.dashboard.head import DashboardServer, start_dashboard

__all__ = ["DashboardServer", "start_dashboard"]
