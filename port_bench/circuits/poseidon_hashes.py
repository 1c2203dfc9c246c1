"""The program's Poseidon batch circuit: ``BatchPoseidonHash(n_instances,
n_inputs)``, its assignment filled from a request by the batched
Poseidon trace."""


def build(args, device):
    from ethsnarks_tpu_torch.models import BatchPoseidonHash
    return BatchPoseidonHash(args['n_instances'], args['n_inputs'],
                             device=device)


def fill(model, request):
    model.set_witness(request['tuples'])
    return {}
