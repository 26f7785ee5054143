"""One algorithm, two transports on the PyTorch port: priced simulation vs
executed ranks (``examples/transport_backends.py``'s twin).

    PYTHONPATH=src python examples/transport_backends_torch.py [--device cpu]

The same C2DFB run goes through both `repro_torch.transport` backends.
`SimTransport` wraps the network fabric — the familiar priced-simulation
path, bit-exact with passing the fabric directly.  `DeviceTransport` puts
one bilevel node on each rank of a `NodeMesh` and EXECUTES every gossip
exchange: the ranks are rows of the stacked tensors on ``--device``
(``cuda`` unless asked for ``cpu``; with no card it raises), neighbour
shifts carry the compressed residuals between them, and every message
makes the wire-codec encode -> decode round trip, so the byte counts are
produced by running serialization code, not by an estimator.  No device
flag is needed: every rank lives in this one process on one device.
"""

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.c2dfb import C2DFBConfig, run
from repro_torch.core.topology import ring
from repro_torch.data.bilevel_tasks import coefficient_tuning_task
from repro_torch.net import make_fabric
from repro_torch.transport import DeviceTransport, SimTransport


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    m, T = 8, 6
    bundle = coefficient_tuning_task(m=m, n=800, p=60, c=5, h=0.8, seed=0, device=device)
    topo = ring(m)
    cfg = C2DFBConfig(
        lam=10.0, eta_out=0.2, gamma_out=0.5, eta_in=0.2, gamma_in=0.4,
        K=6, compressor="topk", comp_ratio=0.3,
    )

    backends = {
        "sim   ": SimTransport(make_fabric(topo, profile="wan", seed=0)),
        "device": DeviceTransport(link="wan", seed=0),
    }
    print(f"{m} nodes on a ring, {T} rounds, topk-compressed inner loops\n")
    for name, transport in backends.items():
        state, mets = run(
            bundle.problem, topo, cfg, bundle.x0, bundle.y0, T=T,
            generator=torch.Generator(device=device).manual_seed(0), device=device,
            transport=transport,
        )
        err = float(mets["y_consensus_err"][-1])
        print(
            f"[{name}] consensus_err={err:.3e}  "
            f"wire_MB={np.asarray(mets['wire_bytes']).sum() / 1e6:.2f}  "
            f"sim_s={np.asarray(mets['sim_seconds']).sum():.1f}"
            + (
                f"  wall_s={np.asarray(mets['wall_seconds']).sum():.1f}"
                if "wall_seconds" in mets
                else ""
            )
        )
    print(
        "\nSame math, same wire format — the device row was executed as "
        "in-process ranks on one device\nwith codec-serialized payloads; the sim row "
        "was priced on the link model."
    )


if __name__ == "__main__":
    main()
