"""Sharding over several devices: one process drives a list of devices.

A shard is a ``torch.device`` with its own tensors, the mesh is a tuple
of devices (:func:`sharding.make_device_mesh`; a device may repeat), a
halo exchange is an explicit copy between shards and a sum over the mesh
is a sum of per-shard partials on the first device, in shard order.
"""
