"""The launcher: the port of ``horovod_tpu/runner``.

``python -m horovod_tpu_torch.runner.run`` (``hvdrun-torch``) is the
command line: host and slot allocation (``hosts``), the flags as ``HVD_*``
variables (``config_parser``), local and ssh spawning with fail-fast and
elastic supervision (``launch``), the ssh pre-check (``ssh_check``), the
NIC ring probe (``nic_probe``), the mpirun and jsrun modes (``mpi``,
``lsf``), the rendezvous KV server with mirrored standbys and its client
(``http_server``, ``http_client``, ``secret``), the MPI-style launchers'
variables (``discovery``) and the function mode's worker (``run_task``).
``from horovod_tpu_torch.runner.run import run`` is the programmatic entry
point.
"""
