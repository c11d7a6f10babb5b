"""Training of the PyTorch port: losses, LR multipliers, optimizer / EMA
state and the trainers (slice 2: KEEP's stage-II step)."""
