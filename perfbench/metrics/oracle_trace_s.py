"""Host seconds the process spent tracing the oracles' gradients
(``OracleGraphs._trace``: ``make_fx`` and its passes), read from the
program's counter (``repro_torch.obs.compute.oracle_graph_traces``): set-up
work, since no round after the first traces.  None where the program keeps
no such counter or traced nothing."""


def read(ctx):
    from repro_torch.obs import compute

    counter = getattr(compute, "oracle_graph_traces", None)
    if counter is None:
        return None
    traced = counter()
    return traced["seconds"] if traced["graphs"] else None
