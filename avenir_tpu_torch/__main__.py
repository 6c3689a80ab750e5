"""``python -m avenir_tpu_torch <Verb> IN OUT --conf P [-D k=v] [--device cpu]``."""

import sys

from avenir_tpu_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
