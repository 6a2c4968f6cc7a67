"""train substrate: the Trainer and its step (trainer), retrieval-tower
training (retrieval_trainer) and ranking metrics (metrics)."""
