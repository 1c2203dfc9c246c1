"""Host helpers: native library names and the libsnark bit packing (own
copy of ``ethsnarks_tpu/utils/__init__.py``)."""

import platform


def native_lib_path(libname):
    """``libname`` with this platform's shared-library suffix."""
    system = platform.uname()[0]
    if system == "Windows":
        extn = ".dll"
    elif system == "Darwin":
        extn = ".dylib"
    else:
        extn = ".so"
    return libname + extn


def bytes_to_field_elements(in_bytes, chunk_size=253):
    """A byte string -> field elements of ``chunk_size`` bits each: bits
    MSB-first per byte, each chunk reversed before conversion (libsnark's
    packing)."""
    assert isinstance(in_bytes, bytes)
    as_bits = ''.join(bin(b)[2:].rjust(8, '0') for b in in_bytes)
    chunks = [as_bits[i:i + chunk_size][::-1]
              for i in range(0, len(as_bits), chunk_size)]
    return [int(c, 2) for c in chunks]


def libsnark2python(inputs):
    """253-bit libsnark field-bit outputs -> 256-bit hex words."""
    bin_inputs = []
    for x in inputs:
        binary = bin(x)[2:][::-1]
        if len(binary) > 100:
            binary = binary.ljust(253, "0")
        bin_inputs.append(binary)
    raw = "".join(bin_inputs)
    raw += "0" * (256 * 5 - len(raw))
    output = []
    for i in range(0, len(raw), 256):
        hexnum = hex(int(raw[i:i + 256], 2))
        padding = 66 - len(hexnum)
        hexnum = hexnum[:2] + "0" * padding + hexnum[2:]
        output.append(hexnum)
    return output
