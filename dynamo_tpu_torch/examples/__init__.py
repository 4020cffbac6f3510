"""The port's serving graphs, mirroring the repo's top-level ``examples/``
(run them with ``python -m dynamo_tpu_torch.cli.serve``)."""
