"""Batched serving on the PyTorch port over the public API (prefill +
autoregressive decode with ring-buffer SWA caches on a MoE model;
``examples/serve_batch.py``'s twin).

    PYTHONPATH=src python examples/serve_batch_torch.py --arch mixtral-8x7b [--device cpu]

Serves on ``--device`` (``cuda`` unless asked for ``cpu``; with no card it
raises).
"""

import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    serve_main([
        "--arch", args.arch, "--smoke",
        "--batch", "4", "--prompt-len", "64", "--gen", "16",
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
