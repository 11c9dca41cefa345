"""HaplotypeCaller: TPU-native reimplementation of the reference's
variant-calling engine (reference: filters/haplotypecaller.go and its
sub-engines)."""
