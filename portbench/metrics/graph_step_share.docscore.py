"""Share of the window's plain decode steps that the program replayed from
CUDA graphs, in %: engine.stats' graph_steps over decode_steps in the
window.  None where no decode step ran, or where the program keeps no
graph_steps counter."""


def read(run):
    steps = run.delta('decode_steps')
    if not steps or 'graph_steps' not in run.stats1:
        return None
    return 100.0 * run.delta('graph_steps') / steps
