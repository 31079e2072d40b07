import sys

from generativeaiexamples_tpu_torch.lint.cli import main

if __name__ == "__main__":
    sys.exit(main())
