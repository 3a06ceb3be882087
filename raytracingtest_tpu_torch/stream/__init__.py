"""The streamed world: a chunk octree on the host (``chunk_octree``), the
clipmap of chunk SVOs in arenas on the card (``clipmap``), and the
slice-based incremental build (``slices``)."""
