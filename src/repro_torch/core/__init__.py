"""Endpoint categories and their mlx5 resource model, sharing plans,
dispatch plans and the adaptive controller (the part the serving path
uses)."""
