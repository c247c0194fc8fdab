"""No mesh in the reference: one device, nothing sharded."""


def seq_sharding(mesh):
    return None


def batch_sharding(mesh):
    return None
