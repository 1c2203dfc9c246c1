"""MiMC command line (own copy of ``ethsnarks_tpu/mimc/__main__.py``).

    python -m ethsnarks_tpu_torch.mimc [options] <test|constants|encrypt|hash> [args]
"""
import argparse
import sys

from ..field import SNARK_SCALAR_FIELD
from .permutation import (
    mimc, mimc_hash, mimc_constants, DEFAULT_EXPONENT, DEFAULT_ROUNDS,
    DEFAULT_SEED)


def main(argv=None):
    parser = argparse.ArgumentParser("MiMC")
    parser.add_argument('-r', '--rounds', metavar='N', type=int,
                        default=DEFAULT_ROUNDS)
    parser.add_argument('-e', '--exponent', metavar='N', type=int,
                        default=DEFAULT_EXPONENT)
    parser.add_argument('-s', '--seed', type=str, default=None)
    parser.add_argument('-k', '--key', type=int, default=0)
    parser.add_argument('-v', '--verbose', action='store_true', default=False)
    parser.add_argument('cmd', nargs='?', default='test')
    parser.add_argument('subargs', nargs='*')
    args = parser.parse_args(argv)

    seed = args.seed.encode('ascii') if args.seed else DEFAULT_SEED
    key = int(args.key)

    if args.verbose:
        print('# exponent', args.exponent)
        print('# rounds', args.rounds)
        print('# seed', seed)
        print('# key', key)

    if args.cmd == 'test':
        assert mimc(1, 1) == 2447343676970420247355835473667983267115132689045447905848734383579598297563
        assert mimc_hash([1, 1]) == 4087330248547221366577133490880315793780387749595119806283278576811074525767
        print('OK')
        return 0
    if args.cmd == 'constants':
        for c in mimc_constants(seed, SNARK_SCALAR_FIELD, args.rounds):
            print(c % SNARK_SCALAR_FIELD)
        return 0
    if args.cmd == 'encrypt':
        for x in args.subargs:
            result = mimc(int(x), key, seed, SNARK_SCALAR_FIELD,
                          args.exponent, args.rounds)
            key = mimc(key, key, seed, SNARK_SCALAR_FIELD,
                       args.exponent, args.rounds)
            print(result)
        return 0
    if args.cmd == 'hash':
        print(mimc_hash([int(x) for x in args.subargs], key, seed,
                        SNARK_SCALAR_FIELD, args.exponent, args.rounds))
        return 0
    parser.print_help()
    return 1


if __name__ == '__main__':
    sys.exit(main())
