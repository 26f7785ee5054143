"""C2DFB core: node-stacked trees, topologies, gossip, bilevel oracles,
compressors, the compressed gradient-tracking inner loop and the outer
loop (``repro.core``'s counterparts)."""
