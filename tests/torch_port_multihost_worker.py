"""Worker: forms the port's process group through the launcher's
rendezvous (``init_torch_distributed``), then allreduces over gloo.

Run under ``python -m horovod_tpu.runner.run -np N -- python <this file>``
(or alone: one process, where ``init_torch_distributed`` is a no-op).
Imports only torch and the port."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch.parallel.multihost import \
    init_torch_distributed  # noqa: E402

init_torch_distributed()
hvd.init(device="cpu")
rank, size = hvd.rank(), hvd.size()
out = hvd.allreduce(torch.full((4,), float(rank + 1)), op=hvd.Sum)
assert torch.equal(out, torch.full((4,), size * (size + 1) / 2)), out
print(f"rank {rank} of {size}: store {os.environ.get('MASTER_ADDR')}:"
      f"{os.environ.get('MASTER_PORT')}, signed "
      f"{bool(os.environ.get('HVD_SECRET_KEY'))}, allreduce OK", flush=True)
hvd.shutdown()
