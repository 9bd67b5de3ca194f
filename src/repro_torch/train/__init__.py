"""Online in-memory training of a deployed IMPACT system."""
from .online import OnlineTrainer

__all__ = ["OnlineTrainer"]
