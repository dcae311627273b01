"""The port's distributed side on ``torch.distributed`` (mirrors
``repro.distributed``): ``halo`` (exchanges and slab-local operators),
``compression`` (int8 halo payloads and the cross-pod gradient mean),
``group`` (process groups), ``claire_dist`` (the slab solve) and
``sharding`` (the LM's sharding rules and the blocks of a mesh)."""
