import sys

from cdk_torch.cli import main

sys.exit(main())
