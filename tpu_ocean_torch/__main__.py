import sys

from tpu_ocean_torch.demo import main

sys.exit(main())
