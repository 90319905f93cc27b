"""Multi-process parallelism over ``torch.distributed`` (port of
climate2weather_tpu/parallel/): one process per card, as torchrun launches
it."""
