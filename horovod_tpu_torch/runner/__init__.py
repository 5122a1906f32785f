"""Launcher-side helpers (port of horovod_tpu/runner/): the rendezvous KV
server and its clients (``rendezvous``), host and slot parsing
(``hosts``), worker processes (``exec``), the elastic worker's
rendezvous client (``worker``) and the elastic driver
(``elastic_driver``).  The ``horovodrun`` CLI, the per-slot GPU plan and
the NIC probe are not ported yet."""
