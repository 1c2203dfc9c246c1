"""The program's membership circuit: ``BatchMerkleMembership(depth,
n_proofs)``, its assignment filled from a request by the program's own
tree and batched MiMC trace."""


def build(args, device):
    from ethsnarks_tpu_torch.models import BatchMerkleMembership
    return BatchMerkleMembership(args['depth'], args['n_proofs'],
                                 device=device)


def fill(model, request):
    """The tree over the request's leaves, then ``set_witness`` ->
    {'trace_seconds': the batched trace's synchronised seconds}."""
    from ethsnarks_tpu_torch.merkletree import MerkleTree
    tree = MerkleTree(1 << model.depth)
    tree.extend(request['leaves'])
    model.set_witness(tree, request['indices'])
    return {'trace_seconds': model.trace_seconds}
