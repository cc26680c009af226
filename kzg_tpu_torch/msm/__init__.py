from .pippenger import msm, msm_g1, point_sum, pick_window

__all__ = ["msm", "msm_g1", "point_sum", "pick_window"]
