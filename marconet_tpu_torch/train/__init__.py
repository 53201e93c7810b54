"""The three-phase GAN trainer and what it needs: losses, discriminators,
LPIPS, the train step and checkpoints."""
