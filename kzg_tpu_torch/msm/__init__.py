from .pippenger import msm, msm_g1, msm_g2, point_sum, pick_window

__all__ = ["msm", "msm_g1", "msm_g2", "point_sum", "pick_window"]
