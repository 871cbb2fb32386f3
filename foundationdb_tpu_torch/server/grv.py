"""GRV proxy: hands out read versions.

Ref parity: fdbserver/GrvProxyServer.actor.cpp — a read version is the
latest committed version, so reads observe every prior commit (external
consistency). The ratekeeper's admission gate and the batching front end
are not ported yet.
"""

from foundationdb_tpu_torch.core.errors import err


class GrvProxy:
    def __init__(self, sequencer):
        self.sequencer = sequencer
        self.grv_count = 0

    def get_read_version(self):
        if not self.sequencer.alive:
            raise err("process_behind")
        self.grv_count += 1
        return self.sequencer.committed_version

    def status(self):
        return {"alive": self.sequencer.alive, "grv_grants": self.grv_count}
