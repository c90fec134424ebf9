from .spatial import plan_windows, receptive_radius, window_starts

__all__ = ["plan_windows", "receptive_radius", "window_starts"]
