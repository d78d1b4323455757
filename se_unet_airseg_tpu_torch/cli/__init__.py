"""Command-line entry points of the port: `python -m
se_unet_airseg_tpu_torch.cli.predict` (deployment) and `.cli.test`
(test-set evaluation)."""
