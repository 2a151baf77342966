"""Training: the chunked cross-entropy (``loss``) and the microbatched,
remat'd train step (``train_step``)."""
