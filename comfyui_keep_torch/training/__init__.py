"""Training of the PyTorch port: losses, LR multipliers, optimizer / EMA
state with save and resume, the trainers (KEEP stage II and III,
StyleGAN2) and the train loop (`train.train_pipeline`)."""
