"""repro_torch.distributed -- the port's checkpointing of torch tensor
trees (``repro_torch.distributed.checkpoint``) and the optimizers over them
(``repro_torch.distributed.optimizer``)."""
