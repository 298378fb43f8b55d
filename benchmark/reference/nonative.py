"""The reference's stand-in for the port's `native` module: every entry
returns None, which is what the port's calls return where no native library
was built, so each call site takes its exact numpy or Python path. The
reference loads no native library."""


def _none(*_args, **_kw):
    return None


(decode_cigar_native, cal_fuzzy_len_native, logf_native, sdust_native,
 zdrop_scan, fix_update_extra, update_extra_scan, exts2_batch_native,
 extd2_batch_native, fix_bad_ends_native, enum_fill_cuts_native, _np_ptr,
 enum_fill_cuts_hpc_native, align_skeleton_native, chain_dp_native,
 map_unit_native, map_unit_ok, sketch_batch_native, est_err_merge,
 cigar_str_native, collect_seeds_native) = (_none,) * 21
