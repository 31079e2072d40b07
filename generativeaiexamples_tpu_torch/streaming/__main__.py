"""`python -m generativeaiexamples_tpu_torch.streaming [--device cpu]`:
the streaming chain server (see streaming/server.py)."""

from generativeaiexamples_tpu_torch.streaming.server import main

if __name__ == "__main__":
    main()
