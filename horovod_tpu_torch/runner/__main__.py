"""`python -m horovod_tpu_torch.runner` — same entry as
`horovodrun_tpu_torch`."""

from .launch import main

main()
