"""Seeded REP006 violations: loops over the whole client population in
the store's residency regions (they run once per cohort)."""


class Store:
    def prefetch_cids(self, cids):
        for c in self.clients:
            if c.cid in cids:
                self.stage(c.cid)

    def _evict(self, cid):
        return min(c.cid for c in self.clients if c.cid != cid)

    def acquire_cohort(self, cids, clients):
        return [self.slot(c) for c in clients]
