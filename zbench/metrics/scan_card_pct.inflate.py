"""scan_card_pct.inflate: the stream bytes the device inflate's block
planner scanned for headers on the card (the port's inflate.scan_card
counter) over those it scanned on the card or on the host
(inflate.scan_card + inflate.scan_host), in %; none from a program
without the counters, or from a window that scanned nothing."""


def read(run):
    card = run.counters.get("inflate.scan_card", 0)
    host = run.counters.get("inflate.scan_host", 0)
    if run.entry != "inflate" or not run.calls or card + host == 0:
        return None
    return 100.0 * card / (card + host)
