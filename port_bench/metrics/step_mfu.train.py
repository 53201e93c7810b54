"""Operations of one reference step at the cell's shapes (counted by
torch.utils.flop_counter over the reference), times the steps, over the
window, as a share of the f32 peak, in %."""

from port_bench import readers


def read(rec):
    return readers.train_mfu_pct(rec)
