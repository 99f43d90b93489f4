import sys

from defer_tpu_torch.analysis.runner import main

if __name__ == "__main__":
    sys.exit(main())
