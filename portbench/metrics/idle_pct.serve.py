"""Share of the traced serving window with no kernel or copy on the card,
percent, from the stretch that traced the device alone (the host at its
untraced pace)."""

from portbench import readers


def read(run):
    return readers.idle_pct(run)
