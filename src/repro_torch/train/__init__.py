"""train substrate: optimizer construction (trainer) and metrics."""
