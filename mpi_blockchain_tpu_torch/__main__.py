from .cli import main
from .parallel.distributed import exit_process

exit_process(main())
