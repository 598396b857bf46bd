from .dynamic import DynamicPlugin, spread_score

__all__ = ["DynamicPlugin", "spread_score"]
