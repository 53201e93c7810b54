"""The three-phase GAN trainer and what it needs: losses, discriminators,
LPIPS, the train step and checkpoints; and the driver around it: the YAML
config, the loop, its event files and validation visuals."""
