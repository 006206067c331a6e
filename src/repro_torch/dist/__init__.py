"""The distribution layer: the mesh context over `torch.distributed`
process groups (`mesh_ctx`), partition specs and `shard_tree`
(`sharding`), and the collectives: the single-device cross-entropy and
tensor parallelism's serving collectives (`collectives`)."""
