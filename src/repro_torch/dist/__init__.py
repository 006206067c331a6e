"""The distribution layer: the mesh context over `torch.distributed`
process groups and the training layout (`mesh_ctx`), partition specs and
`shard_tree` (`sharding`), the collectives: the cross-entropy, tensor
parallelism's serving collectives and the training pairs with their
gradients (`collectives`), and the GPipe microbatch pipeline over the pod
axis (`pipeline`)."""
