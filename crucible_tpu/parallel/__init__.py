"""Multi-chip / multi-host scaling: device meshes, sharded render drivers,
and distributed initialization.

Replacement for the reference's single-host thread pool
(src/camera/cpu_threading.rs, SURVEY.md §2.7): rays/pixels shard over the
device mesh, the scene/BVH replicate into each device's memory, the
framebuffer gathers over the interconnect, and parameter gradients
all-reduce via psum inserted by XLA under jit.
"""
