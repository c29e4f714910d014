"""Multi-device layer of the port (counterpart of tapnet_tpu/parallel/):
`mesh` (the (data, model) grid of ranks over `torch.distributed`, batch and
time shards, collectives that carry gradients), `launch` (spawning ranks,
or joining `torchrun`'s) and `sequence` (the RG-LRU recurrence and the
causal conv with the time axis split over ranks)."""
