"""r50_conv_roofline.offline (layer models.resnet50 cuDNN convs): % of the
device time in cuDNN's convs (`yardstick_r50.conv_device_s`: the kind
'cuDNN convs' and the GEMM kernels cuDNN runs 1x1 convs as) that the
roofline bounds of ResNet50's convs account for: `yardstick_r50.conv_bound_ms`
of the 53 trunk convs and the float32 heads at the shard's batch, times
the traced calls, over that time; None off the card or for another
architecture."""
from benchmarks import readers, yardstick_r50


def read(run):
    if not run.trace or not run.trace['device_events']:
        return None
    m, chips = run.cell.config['model'], run.cell.chips
    conv_ms = yardstick_r50.conv_device_s(run.trace) * 1e3
    if m.get('architecture') != 'resnet50' or conv_ms <= 0.0:
        return None
    shard = run.cell.traffic['batch'] // chips
    bound = sum(yardstick_r50.conv_bound_ms(shard, c) for c in yardstick_r50.conv_shapes(
        m['output_stride'], *readers.model_hw(run)))
    return 100.0 * bound * run.trace_calls * chips / conv_ms
