"""Device ops: the nn1 kernel and its plain version, voxel prune, kNN,
geometric features, segment reductions; host cut pursuit and components."""
