"""Share (%) of K4's scored (query, row) pairs that some query needs: the
probed pairs of the traced blocks (the harness's roofline probes and
cluster sizes, counted as ``roofline.block_work`` counts them) over the sum
of ``lb_pairs`` (padded queries times the plane's rows) on the traced
sub-window's ``search.dispatch`` spans. None where no span carries
``lb_pairs`` or the run took no roofline counts."""

from portbench import spans


def read(run):
    rf = run.roofline
    found = spans.traced(run)
    if rf is None or found is None or run.trace is None:
        return None
    scored = sum(s.counts["lb_pairs"] for s in found
                 if s.name == "search.dispatch" and "lb_pairs" in s.counts)
    if not scored:
        return None
    probed = sum(int(rf["sizes"][rf["probes"][block]].sum()) for block in run.trace.blocks)
    return 100.0 * probed / scored
