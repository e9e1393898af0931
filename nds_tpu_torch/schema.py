# Copied from nds_tpu/schema.py; only import paths changed.
"""Schema registry: single source of truth for the NDS table schemas.

24 source (query) tables plus 12 data-maintenance staging tables, expressed in a
compact column-spec DSL and materializable as pyarrow schemas (for CSV ingest and
the Parquet warehouse) or engine logical types.

Capability parity with the reference registry (``/root/reference/nds/nds_schema.py``:
``get_schemas`` :49-568, ``get_maintenance_schemas`` :570-716), including its
``use_decimal`` toggle (decimal vs double, :43-47) and the identifier-width policy
(int32 surrogate keys except the two 64-bit ticket/order columns, :61-65,328-331).
The representation here is original: a parsed DSL rather than Spark StructTypes.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from enum import Enum
from functools import lru_cache

import pyarrow as pa


class Kind(Enum):
    ID = "id"          # surrogate key, int32
    ID64 = "id64"      # surrogate key, int64 (ss_ticket_number, sr_ticket_number)
    INT = "int"        # general integer (int64, matches reference LongType)
    INT32 = "int32"    # 32-bit integer (maintenance staging tables)
    DEC = "dec"        # decimal(precision, scale)
    STR = "str"        # char(n)/varchar(n)/string — all logical strings
    DATE = "date"      # calendar date


@dataclass(frozen=True)
class ColType:
    kind: Kind
    precision: int = 0
    scale: int = 0
    length: int = 0

    @property
    def is_numeric(self) -> bool:
        return self.kind in (Kind.ID, Kind.ID64, Kind.INT, Kind.INT32, Kind.DEC)


@dataclass(frozen=True)
class Column:
    name: str
    ctype: ColType
    nullable: bool = True


@dataclass(frozen=True)
class TableSchema:
    name: str
    columns: tuple[Column, ...]

    @property
    def column_names(self) -> list[str]:
        return [c.name for c in self.columns]

    def column(self, name: str) -> Column:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(f"{self.name} has no column {name}")

    def arrow_schema(self, use_decimal: bool = True) -> pa.Schema:
        return pa.schema(
            [pa.field(c.name, _arrow_type(c.ctype, use_decimal), nullable=c.nullable)
             for c in self.columns]
        )


def _arrow_type(t: ColType, use_decimal: bool) -> pa.DataType:
    if t.kind == Kind.ID:
        return pa.int32()
    if t.kind == Kind.ID64:
        return pa.int64()
    if t.kind == Kind.INT:
        return pa.int64()
    if t.kind == Kind.INT32:
        return pa.int32()
    if t.kind == Kind.DEC:
        return pa.decimal128(t.precision, t.scale) if use_decimal else pa.float64()
    if t.kind == Kind.DATE:
        return pa.date32()
    return pa.string()


_SPEC_RE = re.compile(
    r"^(?P<name>\w+)\s+"
    r"(?P<type>id64|id|int32|int|date|str|dec\((\d+),(\d+)\)|(?:char|varchar)\((\d+)\))"
    r"(?P<nn>!)?$"
)


def _parse_col(spec: str) -> Column:
    m = _SPEC_RE.match(spec.strip())
    if not m:
        raise ValueError(f"bad column spec: {spec!r}")
    t = m.group("type")
    if t == "id":
        ctype = ColType(Kind.ID)
    elif t == "id64":
        ctype = ColType(Kind.ID64)
    elif t == "int":
        ctype = ColType(Kind.INT)
    elif t == "int32":
        ctype = ColType(Kind.INT32)
    elif t == "date":
        ctype = ColType(Kind.DATE)
    elif t == "str":
        ctype = ColType(Kind.STR)
    elif t.startswith("dec"):
        ctype = ColType(Kind.DEC, precision=int(m.group(3)), scale=int(m.group(4)))
    else:  # char(n)/varchar(n)
        ctype = ColType(Kind.STR, length=int(m.group(5)))
    return Column(m.group("name"), ctype, nullable=m.group("nn") is None)


def _table(name: str, *col_specs: str) -> TableSchema:
    cols = []
    for group in col_specs:
        # split on commas that are not inside a type's parentheses
        for spec in re.split(r",(?![^(]*\))", group):
            spec = spec.strip()
            if spec:
                cols.append(_parse_col(spec))
    return TableSchema(name, tuple(cols))


# ---------------------------------------------------------------------------
# 24 source tables (reference nds_schema.py:67-567)
# ---------------------------------------------------------------------------

_ADDRESS_COLS = ("street_number char(10), street_name varchar(60), street_type char(15), "
                 "suite_number char(10), city varchar(60), county varchar(30), state char(2), "
                 "zip char(10), country varchar(20)")


def _addr(prefix: str) -> str:
    return ", ".join(f"{prefix}_{c.strip()}" for c in _ADDRESS_COLS.split(","))


_SOURCE_TABLES: tuple[TableSchema, ...] = (
    _table(
        "customer_address",
        "ca_address_sk id!, ca_address_id char(16)!",
        _addr("ca"),
        "ca_gmt_offset dec(5,2), ca_location_type char(20)",
    ),
    _table(
        "customer_demographics",
        "cd_demo_sk id!, cd_gender char(1), cd_marital_status char(1)",
        "cd_education_status char(20), cd_purchase_estimate int, cd_credit_rating char(10)",
        "cd_dep_count int, cd_dep_employed_count int, cd_dep_college_count int",
    ),
    _table(
        "date_dim",
        "d_date_sk id!, d_date_id char(16)!, d_date date",
        "d_month_seq int, d_week_seq int, d_quarter_seq int, d_year int, d_dow int",
        "d_moy int, d_dom int, d_qoy int, d_fy_year int, d_fy_quarter_seq int",
        "d_fy_week_seq int, d_day_name char(9), d_quarter_name char(6), d_holiday char(1)",
        "d_weekend char(1), d_following_holiday char(1), d_first_dom int, d_last_dom int",
        "d_same_day_ly int, d_same_day_lq int, d_current_day char(1), d_current_week char(1)",
        "d_current_month char(1), d_current_quarter char(1), d_current_year char(1)",
    ),
    _table(
        "warehouse",
        "w_warehouse_sk id!, w_warehouse_id char(16)!, w_warehouse_name varchar(20)",
        "w_warehouse_sq_ft int",
        _addr("w"),
        "w_gmt_offset dec(5,2)",
    ),
    _table(
        "ship_mode",
        "sm_ship_mode_sk id!, sm_ship_mode_id char(16)!, sm_type char(30)",
        "sm_code char(10), sm_carrier char(20), sm_contract char(20)",
    ),
    _table(
        "time_dim",
        "t_time_sk id!, t_time_id char(16)!, t_time int!, t_hour int, t_minute int",
        "t_second int, t_am_pm char(2), t_shift char(20), t_sub_shift char(20)",
        "t_meal_time char(20)",
    ),
    _table("reason", "r_reason_sk id!, r_reason_id char(16)!, r_reason_desc char(100)"),
    _table("income_band", "ib_income_band_sk id!, ib_lower_bound int, ib_upper_bound int"),
    _table(
        "item",
        "i_item_sk id!, i_item_id char(16)!, i_rec_start_date date, i_rec_end_date date",
        "i_item_desc varchar(200), i_current_price dec(7,2), i_wholesale_cost dec(7,2)",
        "i_brand_id int, i_brand char(50), i_class_id int, i_class char(50)",
        "i_category_id int, i_category char(50), i_manufact_id int, i_manufact char(50)",
        "i_size char(20), i_formulation char(20), i_color char(20), i_units char(10)",
        "i_container char(10), i_manager_id int, i_product_name char(50)",
    ),
    _table(
        "store",
        "s_store_sk id!, s_store_id char(16)!, s_rec_start_date date, s_rec_end_date date",
        "s_closed_date_sk id, s_store_name varchar(50), s_number_employees int",
        "s_floor_space int, s_hours char(20), s_manager varchar(40), s_market_id int",
        "s_geography_class varchar(100), s_market_desc varchar(100)",
        "s_market_manager varchar(40), s_division_id int, s_division_name varchar(50)",
        "s_company_id int, s_company_name varchar(50)",
        _addr("s").replace("s_street_number char(10)", "s_street_number varchar(10)"),
        "s_gmt_offset dec(5,2), s_tax_precentage dec(5,2)",
    ),
    _table(
        "call_center",
        "cc_call_center_sk id!, cc_call_center_id char(16)!",
        "cc_rec_start_date date, cc_rec_end_date date, cc_closed_date_sk id",
        "cc_open_date_sk id, cc_name varchar(50), cc_class varchar(50), cc_employees int",
        "cc_sq_ft int, cc_hours char(20), cc_manager varchar(40), cc_mkt_id int",
        "cc_mkt_class char(50), cc_mkt_desc varchar(100), cc_market_manager varchar(40)",
        "cc_division int, cc_division_name varchar(50), cc_company int",
        "cc_company_name char(50)",
        _addr("cc"),
        "cc_gmt_offset dec(5,2), cc_tax_percentage dec(5,2)",
    ),
    _table(
        "customer",
        "c_customer_sk id!, c_customer_id char(16)!, c_current_cdemo_sk id",
        "c_current_hdemo_sk id, c_current_addr_sk id, c_first_shipto_date_sk id",
        "c_first_sales_date_sk id, c_salutation char(10), c_first_name char(20)",
        "c_last_name char(30), c_preferred_cust_flag char(1), c_birth_day int",
        "c_birth_month int, c_birth_year int, c_birth_country varchar(20), c_login char(13)",
        "c_email_address char(50), c_last_review_date_sk id",
    ),
    _table(
        "web_site",
        "web_site_sk id!, web_site_id char(16)!, web_rec_start_date date",
        "web_rec_end_date date, web_name varchar(50), web_open_date_sk id",
        "web_close_date_sk id, web_class varchar(50), web_manager varchar(40)",
        "web_mkt_id int, web_mkt_class varchar(50), web_mkt_desc varchar(100)",
        "web_market_manager varchar(40), web_company_id int, web_company_name char(50)",
        _addr("web"),
        "web_gmt_offset dec(5,2), web_tax_percentage dec(5,2)",
    ),
    _table(
        "store_returns",
        "sr_returned_date_sk id, sr_return_time_sk id, sr_item_sk id!, sr_customer_sk id",
        "sr_cdemo_sk id, sr_hdemo_sk id, sr_addr_sk id, sr_store_sk id, sr_reason_sk id",
        # 64-bit per accepted TPC-DS benchmark practice (reference nds_schema.py:328-331)
        "sr_ticket_number id64!",
        "sr_return_quantity int, sr_return_amt dec(7,2), sr_return_tax dec(7,2)",
        "sr_return_amt_inc_tax dec(7,2), sr_fee dec(7,2), sr_return_ship_cost dec(7,2)",
        "sr_refunded_cash dec(7,2), sr_reversed_charge dec(7,2), sr_store_credit dec(7,2)",
        "sr_net_loss dec(7,2)",
    ),
    _table(
        "household_demographics",
        "hd_demo_sk id!, hd_income_band_sk id, hd_buy_potential char(15)",
        "hd_dep_count int, hd_vehicle_count int",
    ),
    _table(
        "web_page",
        "wp_web_page_sk id!, wp_web_page_id char(16)!, wp_rec_start_date date",
        "wp_rec_end_date date, wp_creation_date_sk id, wp_access_date_sk id",
        "wp_autogen_flag char(1), wp_customer_sk id, wp_url varchar(100), wp_type char(50)",
        "wp_char_count int, wp_link_count int, wp_image_count int, wp_max_ad_count int",
    ),
    _table(
        "promotion",
        "p_promo_sk id!, p_promo_id char(16)!, p_start_date_sk id, p_end_date_sk id",
        "p_item_sk id, p_cost dec(15,2), p_response_target int, p_promo_name char(50)",
        "p_channel_dmail char(1), p_channel_email char(1), p_channel_catalog char(1)",
        "p_channel_tv char(1), p_channel_radio char(1), p_channel_press char(1)",
        "p_channel_event char(1), p_channel_demo char(1), p_channel_details varchar(100)",
        "p_purpose char(15), p_discount_active char(1)",
    ),
    _table(
        "catalog_page",
        "cp_catalog_page_sk id!, cp_catalog_page_id char(16)!, cp_start_date_sk id",
        "cp_end_date_sk id, cp_department varchar(50), cp_catalog_number int",
        "cp_catalog_page_number int, cp_description varchar(100), cp_type varchar(100)",
    ),
    _table(
        "inventory",
        "inv_date_sk id!, inv_item_sk id!, inv_warehouse_sk id!, inv_quantity_on_hand int",
    ),
    _table(
        "catalog_returns",
        "cr_returned_date_sk id, cr_returned_time_sk id, cr_item_sk id!",
        "cr_refunded_customer_sk id, cr_refunded_cdemo_sk id, cr_refunded_hdemo_sk id",
        "cr_refunded_addr_sk id, cr_returning_customer_sk id, cr_returning_cdemo_sk id",
        "cr_returning_hdemo_sk id, cr_returning_addr_sk id, cr_call_center_sk id",
        "cr_catalog_page_sk id, cr_ship_mode_sk id, cr_warehouse_sk id, cr_reason_sk id",
        "cr_order_number id!, cr_return_quantity int, cr_return_amount dec(7,2)",
        "cr_return_tax dec(7,2), cr_return_amt_inc_tax dec(7,2), cr_fee dec(7,2)",
        "cr_return_ship_cost dec(7,2), cr_refunded_cash dec(7,2)",
        "cr_reversed_charge dec(7,2), cr_store_credit dec(7,2), cr_net_loss dec(7,2)",
    ),
    _table(
        "web_returns",
        "wr_returned_date_sk id, wr_returned_time_sk id, wr_item_sk id!",
        "wr_refunded_customer_sk id, wr_refunded_cdemo_sk id, wr_refunded_hdemo_sk id",
        "wr_refunded_addr_sk id, wr_returning_customer_sk id, wr_returning_cdemo_sk id",
        "wr_returning_hdemo_sk id, wr_returning_addr_sk id, wr_web_page_sk id",
        "wr_reason_sk id, wr_order_number id!, wr_return_quantity int",
        "wr_return_amt dec(7,2), wr_return_tax dec(7,2), wr_return_amt_inc_tax dec(7,2)",
        "wr_fee dec(7,2), wr_return_ship_cost dec(7,2), wr_refunded_cash dec(7,2)",
        "wr_reversed_charge dec(7,2), wr_account_credit dec(7,2), wr_net_loss dec(7,2)",
    ),
    _table(
        "web_sales",
        "ws_sold_date_sk id, ws_sold_time_sk id, ws_ship_date_sk id, ws_item_sk id!",
        "ws_bill_customer_sk id, ws_bill_cdemo_sk id, ws_bill_hdemo_sk id",
        "ws_bill_addr_sk id, ws_ship_customer_sk id, ws_ship_cdemo_sk id",
        "ws_ship_hdemo_sk id, ws_ship_addr_sk id, ws_web_page_sk id, ws_web_site_sk id",
        "ws_ship_mode_sk id, ws_warehouse_sk id, ws_promo_sk id, ws_order_number id!",
        "ws_quantity int, ws_wholesale_cost dec(7,2), ws_list_price dec(7,2)",
        "ws_sales_price dec(7,2), ws_ext_discount_amt dec(7,2), ws_ext_sales_price dec(7,2)",
        "ws_ext_wholesale_cost dec(7,2), ws_ext_list_price dec(7,2), ws_ext_tax dec(7,2)",
        "ws_coupon_amt dec(7,2), ws_ext_ship_cost dec(7,2), ws_net_paid dec(7,2)",
        "ws_net_paid_inc_tax dec(7,2), ws_net_paid_inc_ship dec(7,2)",
        "ws_net_paid_inc_ship_tax dec(7,2), ws_net_profit dec(7,2)",
    ),
    _table(
        "catalog_sales",
        "cs_sold_date_sk id, cs_sold_time_sk id, cs_ship_date_sk id",
        "cs_bill_customer_sk id, cs_bill_cdemo_sk id, cs_bill_hdemo_sk id",
        "cs_bill_addr_sk id, cs_ship_customer_sk id, cs_ship_cdemo_sk id",
        "cs_ship_hdemo_sk id, cs_ship_addr_sk id, cs_call_center_sk id",
        "cs_catalog_page_sk id, cs_ship_mode_sk id, cs_warehouse_sk id, cs_item_sk id!",
        "cs_promo_sk id, cs_order_number id!, cs_quantity int, cs_wholesale_cost dec(7,2)",
        "cs_list_price dec(7,2), cs_sales_price dec(7,2), cs_ext_discount_amt dec(7,2)",
        "cs_ext_sales_price dec(7,2), cs_ext_wholesale_cost dec(7,2)",
        "cs_ext_list_price dec(7,2), cs_ext_tax dec(7,2), cs_coupon_amt dec(7,2)",
        "cs_ext_ship_cost dec(7,2), cs_net_paid dec(7,2), cs_net_paid_inc_tax dec(7,2)",
        "cs_net_paid_inc_ship dec(7,2), cs_net_paid_inc_ship_tax dec(7,2)",
        "cs_net_profit dec(7,2)",
    ),
    _table(
        "store_sales",
        "ss_sold_date_sk id, ss_sold_time_sk id, ss_item_sk id!, ss_customer_sk id",
        "ss_cdemo_sk id, ss_hdemo_sk id, ss_addr_sk id, ss_store_sk id, ss_promo_sk id",
        "ss_ticket_number id64!",
        "ss_quantity int, ss_wholesale_cost dec(7,2), ss_list_price dec(7,2)",
        "ss_sales_price dec(7,2), ss_ext_discount_amt dec(7,2), ss_ext_sales_price dec(7,2)",
        "ss_ext_wholesale_cost dec(7,2), ss_ext_list_price dec(7,2), ss_ext_tax dec(7,2)",
        "ss_coupon_amt dec(7,2), ss_net_paid dec(7,2), ss_net_paid_inc_tax dec(7,2)",
        "ss_net_profit dec(7,2)",
    ),
)

# ---------------------------------------------------------------------------
# 12 maintenance staging tables (reference nds_schema.py:570-716)
# ---------------------------------------------------------------------------

_MAINTENANCE_TABLES: tuple[TableSchema, ...] = (
    _table(
        "s_purchase_lineitem",
        "plin_purchase_id int32!, plin_line_number int32!, plin_item_id char(16)",
        "plin_promotion_id char(16), plin_quantity int32, plin_sale_price dec(7,2)",
        "plin_coupon_amt dec(7,2), plin_comment varchar(100)",
    ),
    _table(
        "s_purchase",
        "purc_purchase_id int32!, purc_store_id char(16), purc_customer_id char(16)",
        "purc_purchase_date char(10), purc_purchase_time int32, purc_register_id int32",
        "purc_clerk_id int32, purc_comment char(100)",
    ),
    _table(
        "s_catalog_order",
        "cord_order_id int32!, cord_bill_customer_id char(16)",
        "cord_ship_customer_id char(16), cord_order_date char(10), cord_order_time int32",
        "cord_ship_mode_id char(16), cord_call_center_id char(16)",
        "cord_order_comments varchar(100)",
    ),
    _table(
        "s_web_order",
        "word_order_id int32!, word_bill_customer_id char(16)",
        "word_ship_customer_id char(16), word_order_date char(10), word_order_time int32",
        "word_ship_mode_id char(16), word_web_site_id char(16)",
        "word_order_comments char(100)",
    ),
    _table(
        "s_catalog_order_lineitem",
        "clin_order_id int32!, clin_line_number int32!, clin_item_id char(16)",
        "clin_promotion_id char(16), clin_quantity int32, clin_sales_price dec(7,2)",
        "clin_coupon_amt dec(7,2), clin_warehouse_id char(16), clin_ship_date char(10)",
        "clin_catalog_number int32, clin_catalog_page_number int32, clin_ship_cost dec(7,2)",
    ),
    _table(
        "s_web_order_lineitem",
        "wlin_order_id int32!, wlin_line_number int32!, wlin_item_id char(16)",
        "wlin_promotion_id char(16), wlin_quantity int32, wlin_sales_price dec(7,2)",
        "wlin_coupon_amt dec(7,2), wlin_warehouse_id char(16), wlin_ship_date char(10)",
        "wlin_ship_cost dec(7,2), wlin_web_page_id char(16)",
    ),
    _table(
        "s_store_returns",
        "sret_store_id char(16), sret_purchase_id char(16)!, sret_line_number int32!",
        "sret_item_id char(16)!, sret_customer_id char(16), sret_return_date char(10)",
        "sret_return_time char(10), sret_ticket_number int, sret_return_qty int32",
        "sret_return_amt dec(7,2), sret_return_tax dec(7,2), sret_return_fee dec(7,2)",
        "sret_return_ship_cost dec(7,2), sret_refunded_cash dec(7,2)",
        "sret_reversed_charge dec(7,2), sret_store_credit dec(7,2), sret_reason_id char(16)",
    ),
    _table(
        "s_catalog_returns",
        "cret_call_center_id char(16), cret_order_id int32!, cret_line_number int32!",
        "cret_item_id char(16)!, cret_return_customer_id char(16)",
        "cret_refund_customer_id char(16), cret_return_date char(10)",
        "cret_return_time char(10), cret_return_qty int32, cret_return_amt dec(7,2)",
        "cret_return_tax dec(7,2), cret_return_fee dec(7,2)",
        "cret_return_ship_cost dec(7,2), cret_refunded_cash dec(7,2)",
        "cret_reversed_charge dec(7,2), cret_merchant_credit dec(7,2)",
        "cret_reason_id char(16), cret_shipmode_id char(16)",
        "cret_catalog_page_id char(16), cret_warehouse_id char(16)",
    ),
    _table(
        "s_web_returns",
        "wret_web_page_id char(16), wret_order_id int32!, wret_line_number int32!",
        "wret_item_id char(16)!, wret_return_customer_id char(16)",
        "wret_refund_customer_id char(16), wret_return_date char(10)",
        "wret_return_time char(10), wret_return_qty int32, wret_return_amt dec(7,2)",
        "wret_return_tax dec(7,2), wret_return_fee dec(7,2)",
        "wret_return_ship_cost dec(7,2), wret_refunded_cash dec(7,2)",
        "wret_reversed_charge dec(7,2), wret_account_credit dec(7,2)",
        "wret_reason_id char(16)",
    ),
    _table(
        "s_inventory",
        "invn_warehouse_id char(16)!, invn_item_id char(16)!, invn_date char(10)!",
        "invn_qty_on_hand int32",
    ),
    _table("delete", "date1 str!, date2 str!"),
    _table("inventory_delete", "date1 str!, date2 str!"),
)


# Single-column unique keys (TPC-DS spec §2 primary keys): every dimension
# table's surrogate key is unique; fact, returns, and inventory tables have
# COMPOSITE primary keys and deliberately list nothing here (inv_date_sk is
# the first column of inventory but repeats per item/warehouse). Consumed by
# the planner's late-materialization legality analysis: a join against one of
# these keys is provably 1:1 per matched probe row, so dimension attributes
# may be gathered after aggregation.
UNIQUE_KEYS: dict[str, tuple[str, ...]] = {
    "customer_address": ("ca_address_sk",),
    "customer_demographics": ("cd_demo_sk",),
    "date_dim": ("d_date_sk",),
    "warehouse": ("w_warehouse_sk",),
    "ship_mode": ("sm_ship_mode_sk",),
    "time_dim": ("t_time_sk",),
    "reason": ("r_reason_sk",),
    "income_band": ("ib_income_band_sk",),
    "item": ("i_item_sk",),
    "store": ("s_store_sk",),
    "call_center": ("cc_call_center_sk",),
    "customer": ("c_customer_sk",),
    "web_site": ("web_site_sk",),
    "household_demographics": ("hd_demo_sk",),
    "web_page": ("wp_web_page_sk",),
    "promotion": ("p_promo_sk",),
    "catalog_page": ("cp_catalog_page_sk",),
}


@lru_cache(maxsize=None)
def get_schemas(use_decimal: bool = True) -> dict[str, TableSchema]:
    """All 24 source-table schemas, keyed by table name.

    ``use_decimal`` is kept for interface parity; the logical schema is identical,
    only ``arrow_schema(use_decimal=...)`` changes the physical decimal mapping.
    """
    del use_decimal
    return {t.name: t for t in _SOURCE_TABLES}


@lru_cache(maxsize=None)
def get_maintenance_schemas(use_decimal: bool = True) -> dict[str, TableSchema]:
    """All 12 maintenance staging-table schemas, keyed by table name."""
    del use_decimal
    return {t.name: t for t in _MAINTENANCE_TABLES}


def all_schemas() -> dict[str, TableSchema]:
    return {**get_schemas(), **get_maintenance_schemas()}


if __name__ == "__main__":
    for nm, sch in all_schemas().items():
        print(f"{nm}: {len(sch.columns)} columns")
