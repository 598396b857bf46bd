"""Ms per dispatched drip window in ``drip_fold`` of the port's stage clock
(the results, ``fold_row`` and ``commit_folds``), over the untraced
window."""

from portbench.readers import stage_ms


def read(obs):
    return stage_ms(obs, "drip_fold")
