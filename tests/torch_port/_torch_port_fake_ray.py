"""A fake ``ray`` with the surface ``horovod_tpu_torch.ray`` uses, whose
actors run in the calling process (after tests/test_integrations.py's
fake ray).  ``test_torch_port_ray.py`` and phase 24 of ``chip_smoke.py``
share it.

An actor that asks for ``num_gpus`` gets the node's next free cards as
Ray gives them: its own ``CUDA_VISIBLE_DEVICES``, set before each of its
methods runs.  ``hostnames[i]``, where given, is what actor ``i``'s
``hostname`` method answers, as actors spread over hosts would.
``record`` collects what the executor asked for: ``pg`` (the placement
group), ``actor_opts`` (each actor's options), ``killed`` and
``pg_removed``."""

import os
import types


def fake_ray_modules(record, gpus_on_node=8, hostnames=None, nodes=None):
    """``{"ray": ..., "ray.util": ..., "ray.util.scheduling_strategies":
    ...}``, for ``sys.modules``; ``nodes`` is what ``ray.nodes()``
    lists."""
    free_cards = list(range(gpus_on_node))
    actors = []

    class Future:
        def __init__(self, value):
            self.value = value

    class Handle:
        def __init__(self, cls, opts):
            self._inst, self._index = cls(), len(actors)
            self._cards = [free_cards.pop(0)
                           for _ in range(int(opts.get("num_gpus", 0)))]
            actors.append(self)

        def __getattr__(self, name):
            if name == "hostname" and hostnames:
                host = hostnames[self._index]
                return types.SimpleNamespace(remote=lambda: Future(host))
            method, cards = getattr(self._inst, name), self._cards

            def remote(*a, **kw):
                if cards:
                    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(
                        map(str, cards))
                return Future(method(*a, **kw))
            return types.SimpleNamespace(remote=remote)

    class ActorClass:
        def __init__(self, cls):
            self._cls = cls

        def options(self, **opts):
            record.setdefault("actor_opts", []).append(opts)
            return types.SimpleNamespace(
                remote=lambda: Handle(self._cls, opts))

    class PlacementGroup:
        def __init__(self, bundles, strategy):
            self.bundles, self.strategy = bundles, strategy

        def ready(self):
            return "pg-ready"

    def placement_group(bundles, strategy):
        record["pg"] = PlacementGroup(bundles, strategy)
        return record["pg"]

    class PlacementGroupSchedulingStrategy:
        def __init__(self, placement_group, placement_group_bundle_index):
            self.placement_group = placement_group
            self.placement_group_bundle_index = placement_group_bundle_index

    ray = types.ModuleType("ray")
    ray.remote = ActorClass
    ray.get = lambda x: ([f.value for f in x] if isinstance(x, list)
                         else getattr(x, "value", x))
    ray.kill = lambda w: record.setdefault("killed", []).append(w)
    ray.nodes = lambda: list(nodes or [])
    util = types.ModuleType("ray.util")
    util.placement_group = placement_group
    util.remove_placement_group = \
        lambda pg: record.__setitem__("pg_removed", pg)
    ray.util = util
    sched = types.ModuleType("ray.util.scheduling_strategies")
    sched.PlacementGroupSchedulingStrategy = PlacementGroupSchedulingStrategy
    return {"ray": ray, "ray.util": util,
            "ray.util.scheduling_strategies": sched}
