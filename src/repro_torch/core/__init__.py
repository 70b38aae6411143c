"""Endpoint categories and sharing plans (the part the serving path uses)."""
