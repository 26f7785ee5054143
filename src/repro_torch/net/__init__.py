"""Exact wire codecs for compressed residuals (``repro.net.wire``'s
counterpart).  The fabric, dynamic topologies and transports come in later
slices of the port."""
