"""Command-line entry points of the port: `python -m
se_unet_airseg_tpu_torch.cli.train` (the 3-stage curriculum),
`.cli.predict` (deployment), `.cli.test` (test-set evaluation),
`.cli.tree_parsing` (the two airway-tree parsers), `.cli.preprocess`
and `.cli.write_json` (data preparation)."""
