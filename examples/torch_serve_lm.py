"""Batched serving on the port: prefill + KV-cache decode (ring buffer for
SWA, latent cache for MLA), on the CUDA card by default.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch mixtral-8x22b --gen 24 [--device cpu]

The flags are `repro_torch.launch.serve`'s.
"""
from repro_torch.launch import serve


def main(argv=None) -> None:
    serve.main(argv)


if __name__ == "__main__":
    main()
