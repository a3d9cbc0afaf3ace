"""horovod_tpu_torch.serving: continuous-batching LM inference, the port of
``horovod_tpu/serving``.

* :class:`FrontDoor` (server.py) answers ``POST /generate`` and ``GET
  /stats``/``/health``; the admission :class:`Scheduler` (scheduler.py)
  packs prompts into free decode slots at token boundaries and retires
  them at their token budget.
* :class:`DecodeEngine` (decode.py) holds the slot-batched KV caches and
  steps the flagship transformer's decode (models/transformer.py).
* :class:`ServingLoop` (loop.py) runs on every rank of a gang: rank 0
  broadcasts each step's batch delta over the eager engine's control
  channel (``TAG_SERVE``), so that every rank steps its ``DecodeEngine`` in
  lockstep; each step ends in a token-agreement allreduce; after a rank's
  failure the gang re-forms in process (``@hvd.elastic.run``) and replays
  the in-flight requests from their prompts, and when rank 0 dies the
  lowest survivor takes the lead with the slot table the frames gave it.

Served by a launched gang::

    python -m horovod_tpu_torch.runner.run -np 3 --min-np 2 --serve-max-batch 8 -- python serve.py

where ``serve.py`` builds the model and calls ``ServingLoop(model,
cfg).run()``.
"""

from horovod_tpu_torch.serving.decode import DecodeEngine
from horovod_tpu_torch.serving.loop import ServingLoop
from horovod_tpu_torch.serving.scheduler import QueueFull, Request, Scheduler
from horovod_tpu_torch.serving.server import FrontDoor

__all__ = [
    "DecodeEngine",
    "FrontDoor",
    "QueueFull",
    "Request",
    "Scheduler",
    "ServingLoop",
]
