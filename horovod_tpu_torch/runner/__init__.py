"""Launcher-side helpers (port of horovod_tpu/runner/).  So far only the
HTTP scaffold and the request signature the serving plane shares with
the reference's rendezvous server."""
