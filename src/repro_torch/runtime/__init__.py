"""Fault tolerance of the training loop: checkpoints (``checkpoint``) and
the straggler, hang and preemption watchdog (``watchdog``)."""
