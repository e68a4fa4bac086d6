"""python3 -m gpubench --workload <cell> --seed <n> --seconds <s> --trace <0|1>"""

import sys

from gpubench.run import main

sys.exit(main())
