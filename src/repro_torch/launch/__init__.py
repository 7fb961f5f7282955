"""Entry points of the LM drivers: ``python -m repro_torch.launch.train``
(restartable training over compressed shards, compressed checkpoints) and
``python -m repro_torch.launch.serve`` (prefill + KV-cache decode from such
a checkpoint).  Both run on the card unless ``--device cpu`` is given."""
