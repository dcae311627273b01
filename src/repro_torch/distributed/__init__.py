"""The slab-parallel solve on ``torch.distributed`` (mirrors
``repro.distributed``): ``halo`` (exchanges and slab-local operators),
``compression`` (int8 halo payloads), ``group`` (process groups) and
``claire_dist`` (the slab solve)."""
