import sys

from gubernator_tpu_torch.cmd.server import main

sys.exit(main())
