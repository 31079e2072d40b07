"""`python -m generativeaiexamples_tpu_torch.api --port N [--device cpu]`:
the chain server (see api/server.py)."""

from generativeaiexamples_tpu_torch.api.server import main

if __name__ == "__main__":
    main()
