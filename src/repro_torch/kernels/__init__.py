"""Hand-written Hopper kernels for the port's hot path, with their plain
PyTorch versions (`fcm_update`), their build (`build`) and their engine
backends (`ops`)."""
