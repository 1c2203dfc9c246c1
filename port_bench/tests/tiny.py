"""The cells at a size a CPU test can hold: a depth-1 tree with 2
statements (m = 2^11), 2 Poseidon hashes a batch (m = 2^10)."""

from port_bench import spec


def tiny_cell(name):
    cell = spec.Cell(name)
    if cell.config['circuit'] == 'merkle_membership':
        cell.config['args'] = {'depth': 1, 'n_proofs': 2}
        cell.traffic = dict(cell.traffic, leaves=2, statements=2)
    else:
        cell.config['args'] = {'n_instances': 2, 'n_inputs': 2}
        cell.traffic = dict(cell.traffic, batch=2, pool=3)
    return cell
