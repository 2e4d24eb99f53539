"""Clean twin of rep006_bad: the residency regions walk the cohort or
the prefetch batch and index single clients."""


class Store:
    def prefetch_cids(self, cids):
        for cid in cids:
            self.stage(self.clients[cid].cid)

    def _evict(self, cid):
        return self.lru.pop(cid)

    def acquire_cohort(self, cids):
        return [self.slot(cid) for cid in cids]

    def report(self):
        # not a store region: a population walk here is fine
        return [c.cid for c in self.clients]
