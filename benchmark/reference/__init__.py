"""Plain PyTorch reference of the stage-1 model, the multi-input HiFi-GAN
and the stage-1 training step. Functional over the port's state-dict
names; imports nothing of the port and no kernel. Run it in float32 with
TF32 off (`plain_precision`)."""
