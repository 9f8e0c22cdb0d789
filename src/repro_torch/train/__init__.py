"""Training on the port: loss, AdamW, the train step, data, checkpoints,
fault tolerance and the Trainer, after ``repro/train/``."""
