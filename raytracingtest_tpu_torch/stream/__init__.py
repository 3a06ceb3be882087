"""The streamed world: a chunk octree on the host (``chunk_octree``) and the
clipmap of chunk SVOs in arenas on the card (``clipmap``)."""
